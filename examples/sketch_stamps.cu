// The port's greedy.cu with SM clock stamps of greedy_sketch_kernel's
// phases (its SketchPhase enum), for examples/torch_selection_stamps.py.
// Built with the port's nvcc flags, -I src/repro_torch/kernels/csrc and
// -I examples; its greedy_sketch entry point is the port's, stamped.
#include "phase_clock.cuh"
#include "greedy.cu"

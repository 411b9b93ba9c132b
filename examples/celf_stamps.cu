// The port's celf.cu with SM clock stamps of celf_select_kernel's phases
// (its SelectPhase enum), for examples/torch_selection_stamps.py.  Built
// with the port's nvcc flags, -I src/repro_torch/kernels/csrc and
// -I examples; its celf_select entry point is the port's, stamped.
#include "phase_clock.cuh"
#include "celf.cu"

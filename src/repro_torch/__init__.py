"""PyTorch + CUDA port of the gIM influence-maximization pipeline.

The JAX package ``repro`` is the reference; this package imports neither
``jax`` nor ``repro``.  Every entry point takes ``device=`` (default
``"cuda"``); the CPU runs only when the caller asks for it.  The main path
is one plain IC solve::

    from repro_torch.graph import csr, generators, weights
    from repro_torch.core.imm import IMMSolver
    from repro_torch.core.problem import IMProblem

    src, dst = generators.barabasi_albert(2000, 4, seed=0)
    g = weights.wc_weights(csr.from_edges(src, dst, 2000, device="cuda"))
    res = IMMSolver(g, batch=512, device="cuda").solve(IMProblem(k=10))
"""

"""AGORA planner, PyTorch port.

The same system as the JAX package ``repro`` (the reference), with the
same layout and names, written against PyTorch: plain functions on
tensors, an explicit ``device`` everywhere, explicit random streams. Each
Pallas kernel of the reference is a CUDA kernel written for Hopper
(``kernels/csrc/``): the serial-SGS decode of the vectorized engines, the
capacity-violation mass of the ising engine and the USL runtime grid; on
the CPU their plain PyTorch versions (``kernels/ref.py``) run instead.

Entry points (``core.agora.Agora``, ``Agora.session``, the solver
functions in ``core.vectorized`` and ``core.ising``) default to
``device="cuda"``.
"""

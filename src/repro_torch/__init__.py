"""AGORA planner, PyTorch port.

The same system as the JAX package ``repro`` (the reference), with the
same layout and names, written against PyTorch: plain functions on
tensors, an explicit ``device`` everywhere, explicit random streams. The
solver's hot loop, the serial-SGS decode, is a CUDA kernel written for
Hopper (``kernels/csrc/sgs_decode.cu``); on the CPU its plain PyTorch
version (``kernels/ref.py``) runs instead.

Entry points (``core.agora.Agora``, ``Agora.session``, the engine
functions in ``core.vectorized``) default to ``device="cuda"``.
"""

"""RDF-h in PyTorch and CUDA for an NVIDIA H100.

A port of the JAX package ``repro``, module for module: ``kernels`` holds
the hand-written CUDA kernels and their plain PyTorch versions, ``core``
the engine, ``serve`` the serving tier (``QueryServer``), ``obs``
tracing, metrics and EXPLAIN, ``testing`` fault injection, ``data`` the
generators and ``launch`` the query CLI.  ``configs`` and ``models`` are
the LM scaffold, trained with ``optim`` and ``checkpoint``.  The engine
and the models run on ``cuda`` unless the caller asks for
``device="cpu"``.
"""

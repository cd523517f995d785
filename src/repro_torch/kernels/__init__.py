"""The port's kernels: plain versions (``ref``), hand-written CUDA kernels
(``csrc/`` built by ``build``, wrapped by ``ps_view``) and the dispatch
by device (``ops``)."""

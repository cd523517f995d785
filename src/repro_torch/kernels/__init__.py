"""The port's kernels: plain versions (``ref``), hand-written CUDA kernels
(``csrc/`` built by ``build``, wrapped by ``ps_view`` and ``delta_pack``
with the shared helpers and launch counts of ``launch``) and the dispatch
by device (``ops``)."""

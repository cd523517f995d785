"""The port's kernels: plain versions (``ref``), hand-written CUDA kernels
(``csrc/`` built by ``build``, wrapped by ``ps_view``, ``delta_pack``,
``flash_attention``, ``ssd_scan`` and ``mf_sgd`` with the shared helpers
and launch counts of ``launch``) and the dispatch by device (``ops``)."""

"""The cross-pod communication substrate (``substrate``): k-clock delta
aggregation, top-k sparsified and quantized shipments with an
error-feedback residual.  The lossy wire (``repro/comm/wire.py``) is
ported in a later slice."""

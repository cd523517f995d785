"""The cross-pod communication substrate (``substrate``): k-clock delta
aggregation, top-k sparsified and quantized shipments with an
error-feedback residual; and the lossy wire (``wire``): seeded drop,
duplicate and delay faults answered by an ack/retransmit ARQ."""

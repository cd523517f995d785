"""Readouts of the hierarchical (multi-pod) parameter server
(``reconcile``).  The pods runtime is ported in a later slice."""

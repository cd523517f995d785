"""Trace comparison and contract checks (the sharded runtime is ported in a
later slice)."""

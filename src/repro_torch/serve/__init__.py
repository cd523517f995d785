"""Batched serving: prefill and greedy decode against the caches."""

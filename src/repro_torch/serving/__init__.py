"""Batched serving: prefill + greedy/temperature decode."""

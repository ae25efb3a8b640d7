"""Batched solving (port of `madqp_tpu/parallel`): lockstep solves of
padded batches on one card (`BatchedMPCSolver`, `solve_batched`) and the
padding that `pad_mode="bucket"` also uses (`pad_standard`).  The sparse
batched and two-stage paths are ROADMAP.md Queue 1, items 14 and 11."""

from .batched import BatchedMPCSolver, solve_batched, pad_standard

__all__ = ["BatchedMPCSolver", "solve_batched", "pad_standard"]

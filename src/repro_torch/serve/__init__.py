"""Batched LM serving (fixed slots, per-slot prefill, lockstep decode)."""

"""Checkpoints: a flat-key npz store with step metadata and the plan that
produced the run (counterpart of ``repro.ckpt``)."""

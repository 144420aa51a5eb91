"""PyTorch/CUDA port of the LR-CNN row-centric training system.

This package mirrors ``repro`` (the JAX reference) module for module:
``repro_torch.core.overlap`` is the counterpart of ``repro.core.overlap``,
``repro_torch.exec.kernel_engines`` of ``repro.exec.pallas_engines``, and
so on.  It imports ``torch`` and never ``jax`` or ``repro``.

Layout: every public function keeps the reference's layout — activations
are NHWC and conv weights HWIO, with the row axis (H) as dim 1.  Interval
math, row slices and parity tests then line up one to one with the JAX
package; only the calls into ``torch.nn.functional`` permute to NCHW/OIHW
views internally.

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Kernel wrappers take their plain PyTorch version for a
tensor that lies on the CPU and launch the hand-written CUDA kernel for a
CUDA tensor (or raise); there is no silent fallback on the card.
"""

"""VGG-16 [Simonyan & Zisserman, ICLR'15] — the paper's own benchmark
(counterpart of ``repro.configs.vgg16``; same widths and presets).

The config carries a :class:`PlanRequest`, which the trainer resolves to an
:class:`~repro_torch.exec.plan.ExecutionPlan` through the Planner: the full
preset asks for ``twophase_h`` at N=8 under a 24 GB budget, the reduced one
for ``twophase`` at N=2.  The reduced request is kept verbatim although it
exceeds 2PS's granularity bound at 64² (``max_valid_rows`` is 1 there), so
it raises ``ValueError`` in the port as in the reference; pin another
engine (``--strategy``) or a budget (``--budget-gb``) to train that preset.
"""

import dataclasses

from repro_torch.exec.plan import PlanRequest


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str              # vgg16 | resnet50 | convnext_b384
    image: int = 224
    channels: int = 3
    n_classes: int = 10
    batch: int = 32
    width_mult: float = 1.0
    plan: PlanRequest = PlanRequest(engine="twophase_h", n_rows=8,
                                    budget_gb=24.0)


CONFIG = CNNConfig(name="vgg16", arch="vgg16")


def reduced():
    return CNNConfig(name="vgg16-reduced", arch="vgg16", image=64,
                     width_mult=0.125, batch=2,
                     plan=PlanRequest(engine="twophase", n_rows=2))

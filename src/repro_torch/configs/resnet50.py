"""ResNet-50 [He et al., CVPR'16] — the paper's own benchmark
(counterpart of ``repro.configs.resnet50``; same widths and presets).

The full config takes :class:`~repro_torch.configs.vgg16.CNNConfig`'s
default request (``twophase_h`` at N=8 under a 24 GB budget); the reduced
preset pins ``overlap`` at N=2.
"""
from repro_torch.configs.vgg16 import CNNConfig
from repro_torch.exec.plan import PlanRequest

CONFIG = CNNConfig(name="resnet50", arch="resnet50")


def reduced():
    return CNNConfig(name="resnet50-reduced", arch="resnet50", image=64,
                     width_mult=0.125, batch=2,
                     plan=PlanRequest(engine="overlap", n_rows=2))

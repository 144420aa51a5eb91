"""ConvNeXt-B at 384² [Liu et al., "A ConvNet for the 2020s", CVPR'22,
arXiv:2201.03545]: widths (128, 256, 512, 1024), depths (3, 3, 27, 3), the
ImageNet-1K fine-tuning resolution of the paper's ImageNet-22K models.

At 384² autograd keeps ~675 MB a image (twelve C-wide maps a block, most
of them the two 4C-wide ones), so batch 128 is the first power of two
whose column-centric step outgrows an 80 GB card; the full config asks
for ``twophase_h`` at N=8 under a 24 GB budget, and the 7x7 halos cap
each segment's N (:func:`repro_torch.exec.planner.derive_segments`).
The reduced preset keeps every block and geometry at 64² and an eighth of
the widths, and pins ``overlap`` at N=2.
"""
from repro_torch.configs.vgg16 import CNNConfig
from repro_torch.exec.plan import PlanRequest

CONFIG = CNNConfig(name="convnext_b384", arch="convnext_b384", image=384,
                   n_classes=1000, batch=128)


def reduced():
    return CNNConfig(name="convnext_b384-reduced", arch="convnext_b384",
                     image=64, width_mult=0.125, batch=2,
                     plan=PlanRequest(engine="overlap", n_rows=2))

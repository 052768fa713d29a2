"""ResNet-50 on ImageNet-1K, the paper's §VI-B2 workload."""
from repro_torch.models.cnn.resnet import RESNET50 as CONFIG, ResNetConfig  # noqa: F401 — registry re-export
SMOKE = ResNetConfig(name="resnet-smoke", input_hw=32, n_classes=10,
                     stages=(1, 1, 1, 1), widths=(4, 8, 16, 16))

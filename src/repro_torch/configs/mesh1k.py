"""1K mesh-tangling model (paper §VI): 6 blocks x 3 convs, 1024^2 x 18."""
from repro_torch.models.cnn.meshnet import MESH1K as CONFIG, MeshNetConfig  # noqa: F401 — registry re-export
SMOKE = MeshNetConfig("mesh1k-smoke", input_hw=64, in_channels=4,
                      convs_per_block=1, widths=(8, 16, 16))

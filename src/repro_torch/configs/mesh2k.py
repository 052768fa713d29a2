"""2K mesh-tangling model (paper §VI): 6 blocks x 5 convs, 2048^2 x 18."""
from repro_torch.models.cnn.meshnet import MESH2K as CONFIG, MeshNetConfig  # noqa: F401 — registry re-export
SMOKE = MeshNetConfig("mesh2k-smoke", input_hw=64, in_channels=4,
                      convs_per_block=2, widths=(8, 16, 16))

from dimo_tpu_torch.ops.rasterizer.api import (  # noqa: F401
    RenderOutput, rasterize, rasterize_dense)
from dimo_tpu_torch.ops.rasterizer.tiles import TILE_H, TILE_W  # noqa: F401

from dimo_tpu_torch.ops.rasterizer.api import (  # noqa: F401
    RenderOutput, rasterize, rasterize_dense)

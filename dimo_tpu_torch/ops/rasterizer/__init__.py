from dimo_tpu_torch.ops.rasterizer.api import RenderOutput, rasterize  # noqa: F401

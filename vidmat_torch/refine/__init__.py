"""Refinement helpers of the port (counterpart of vidmat/refine/),
exported lazily."""

from vidmat_torch._exports import lazy_exports

__getattr__ = lazy_exports({"tile_frame": "vidmat_torch.refine.tiling",
                            "untile_frame": "vidmat_torch.refine.tiling",
                            "TileLayout": "vidmat_torch.refine.tiling",
                            "ErrorMapRefiner": "vidmat_torch.refine.errormap"})

from vsr_tpu_torch.masks.intervals import is_frame_number_in_ab_sections
from vsr_tpu_torch.masks.mask import binarize_mask, create_mask
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

__all__ = [
    "binarize_mask",
    "create_mask",
    "get_inpaint_area_by_mask",
    "is_frame_number_in_ab_sections",
]

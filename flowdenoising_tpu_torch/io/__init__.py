"""Volume I/O: MRC2014 and multi-page TIFF (NumPy only)."""

from flowdenoising_tpu_torch.io.volume import read_volume, write_volume
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc, MrcHeader
from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff

__all__ = ["read_volume", "write_volume", "read_mrc", "write_mrc", "MrcHeader",
           "read_tiff", "write_tiff"]

"""Volume I/O: MRC2014 (with the native runtime's fast paths) and
multi-page TIFF."""

from flowdenoising_tpu_torch.io.volume import read_volume, write_volume
from flowdenoising_tpu_torch.io.mrc import read_mrc, write_mrc, MrcHeader
from flowdenoising_tpu_torch.io.tiff import read_tiff, write_tiff

__all__ = ["read_volume", "write_volume", "read_mrc", "write_mrc", "MrcHeader",
           "read_tiff", "write_tiff"]

from jpeg2png_tpu_torch.io.jpeg_reader import (  # noqa: F401
    CoefPlane, JpegImage, read_jpeg, require_supported,
)
from jpeg2png_tpu_torch.io.png_writer import encode_png, write_png  # noqa: F401

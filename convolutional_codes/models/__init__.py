from convolutional_codes.models.codebook import Code, get_code, register_code, list_codes
from convolutional_codes.models.trellis import Trellis, build_trellis

__all__ = ["Code", "get_code", "register_code", "list_codes", "Trellis", "build_trellis"]

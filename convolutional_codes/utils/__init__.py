from convolutional_codes.utils import bitops  # noqa: F401

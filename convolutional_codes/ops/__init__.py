from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.mapper import map_symbols, map_symbols_m
from convolutional_codes.ops.demapper import soft_demap, hard_demap, hard_decide
from convolutional_codes.ops.channels import awgn, bsc, awgn_sigma
from convolutional_codes.ops.viterbi import viterbi_decode_soft, viterbi_decode_hard
from convolutional_codes.ops.stack import stack_decode_soft, stack_decode_hard
from convolutional_codes.ops.fano import fano_decode_soft, fano_decode_hard

__all__ = ["encode", "map_symbols", "map_symbols_m",
           "soft_demap", "hard_demap", "hard_decide",
           "awgn", "bsc", "awgn_sigma",
           "viterbi_decode_soft", "viterbi_decode_hard",
           "stack_decode_soft", "stack_decode_hard",
           "fano_decode_soft", "fano_decode_hard"]

% generated by convolutional_codes sweep runner
x_awgn_viterbi_soft_0 = [0 2 4 6 8 10 12 14];
awgn_viterbi_soft_0 = [0.353293 0.203033 0.056927 0.00567112 0.00013715 4.52995e-07 0 0];
awgn_viterbi_soft_0_fer = [0.869366 0.510174 0.132809 0.0124512 0.000279903 4.76837e-07 0 0];

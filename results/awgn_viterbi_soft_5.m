% generated by convolutional_codes sweep runner
x_awgn_viterbi_soft_5 = [0 2 4 6 8 10 12 14];
awgn_viterbi_soft_5 = [0.116245 0.0387177 0.00815239 0.00122633 0.000118399 4.12464e-06 3.09635e-08 0];
awgn_viterbi_soft_5_fer = [0.871056 0.54924 0.197765 0.0407257 0.00438786 0.000157356 1.23854e-06 0];

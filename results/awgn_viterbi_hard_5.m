% generated by convolutional_codes sweep runner
x_awgn_viterbi_hard_5 = [0 2 4 6 8 10 12 14];
awgn_viterbi_hard_5 = [0.187422 0.0871964 0.0281183 0.0066618 0.00116493 0.000119913 5.40003e-06 8.54591e-08];
awgn_viterbi_hard_5_fer = [0.95927 0.780369 0.436928 0.158997 0.0361857 0.0042901 0.00020421 3.41837e-06];

% generated by convolutional_codes sweep runner
x_awgn_viterbi_hard_2 = [0 2 4 6 8 10 12 14];
awgn_viterbi_hard_2 = [0.250419 0.124459 0.0343779 0.00523109 0.000556672 4.85301e-05 2.09561e-06 8.66977e-09];
awgn_viterbi_hard_2_fer = [0.964161 0.77166 0.365555 0.0841484 0.010829 0.000971794 4.20608e-05 1.98166e-07];

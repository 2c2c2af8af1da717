% generated by convolutional_codes sweep runner
x_awgn_viterbi_soft_2 = [0 2 4 6 8 10 12 14];
awgn_viterbi_soft_2 = [0.156736 0.048942 0.00772009 0.000733185 4.99845e-05 2.7895e-06 1.12707e-07 1.23854e-09];
awgn_viterbi_soft_2_fer = [0.846878 0.457172 0.114902 0.0146904 0.00121641 7.9155e-05 3.26974e-06 4.95415e-08];

% generated by convolutional_codes sweep runner
x_awgn_viterbi_soft_3 = [0 2 4 6 8 10 12 14];
awgn_viterbi_soft_3 = [0.162541 0.0445104 0.00469418 0.000252628 8.60691e-06 1.19209e-07 2.47708e-09 0];
awgn_viterbi_soft_3_fer = [0.793026 0.342319 0.0543137 0.00387192 0.000149727 1.90735e-06 4.95415e-08 0];

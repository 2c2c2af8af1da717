% generated by convolutional_codes sweep runner
x_awgn_viterbi_hard_3 = [0 2 4 6 8 10 12 14];
awgn_viterbi_hard_3 = [0.262694 0.129761 0.0319164 0.00358744 0.000251102 1.60456e-05 7.01013e-07 3.71561e-09];
awgn_viterbi_hard_3_fer = [0.949551 0.7052 0.266975 0.0415344 0.00337839 0.000217915 9.31381e-06 4.95415e-08];

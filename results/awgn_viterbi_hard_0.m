% generated by convolutional_codes sweep runner
x_awgn_viterbi_hard_0 = [0 2 4 6 8 10 12 14];
awgn_viterbi_hard_0 = [0.410706 0.310314 0.147553 0.0311952 0.00224044 4.00901e-05 1.48625e-07 0];
awgn_viterbi_hard_0_fer = [0.97205 0.815701 0.423252 0.0949631 0.00700903 0.000126362 5.44957e-07 0];

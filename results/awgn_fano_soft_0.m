% generated by convolutional_codes sweep runner
x_awgn_fano_soft_0 = [0 2 4 6 8 10 12 14];
awgn_fano_soft_0 = [0.474484 0.3467 0.0647888 0.00561047 0.000135261 8.34562e-07 0 0];
awgn_fano_soft_0_fer = [0.994832 0.761922 0.152262 0.0121289 0.000293467 1.49474e-06 0 0];

% generated by convolutional_codes sweep runner
x_awgn_fano_hard_4 = [0 2 4 6 8 10 12 14];
awgn_fano_hard_4 = [0.396975 0.199675 0.0134888 0.000117187 5.46825e-06 3.2386e-07 1.9991e-08 0];
awgn_fano_hard_4_fer = [0.974365 0.602478 0.0643921 0.00141602 6.41492e-05 4.35965e-06 3.1236e-07 0];

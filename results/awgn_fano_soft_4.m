% generated by convolutional_codes sweep runner
x_awgn_fano_soft_4 = [0 2 4 6 8 10 12 14];
awgn_fano_soft_4 = [0.43369 0.362222 0.0203955 1.2207e-07 0 0 1.24944e-09 0];
awgn_fano_soft_4_fer = [1 0.929749 0.0567017 6.10352e-06 0 0 6.2472e-08 0];

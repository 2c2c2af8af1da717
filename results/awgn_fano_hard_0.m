% generated by convolutional_codes sweep runner
x_awgn_fano_hard_0 = [0 2 4 6 8 10 12 14];
awgn_fano_hard_0 = [0.441881 0.329118 0.146773 0.0309592 0.0022434 3.97227e-05 1.29968e-07 0];
awgn_fano_hard_0_fer = [0.977824 0.822998 0.423299 0.0937891 0.00709652 0.00013353 3.99903e-07 0];

% generated by convolutional_codes sweep runner
x_awgn_fano_soft_3 = [0 2 4 6 8 10 12 14];
awgn_fano_soft_3 = [0.45141 0.314564 0.0245605 0.000269531 9.41685e-06 3.36316e-07 0 0];
awgn_fano_soft_3_fer = [0.994751 0.751343 0.0913086 0.00408691 0.000157944 5.48071e-06 0 0];

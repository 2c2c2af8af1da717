% generated by convolutional_codes sweep runner
x_awgn_stack_soft_3 = [0 2 4 6 8 10 12 14];
awgn_stack_soft_3 = [0.281931 0.132026 0.0241648 0.000774292 9.80299e-06 2.49123e-07 0 0];
awgn_stack_soft_3_fer = [0.966878 0.704102 0.190837 0.00881836 0.000152962 3.98597e-06 0 0];

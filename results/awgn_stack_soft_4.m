% generated by convolutional_codes sweep runner
x_awgn_stack_soft_4 = [0 2 4 6 8 10 12 14];
awgn_stack_soft_4 = [0.38537 0.281667 0.0769666 0.000220215 0 0 0 0];
awgn_stack_soft_4_fer = [0.994507 0.853516 0.275757 0.00103149 0 0 0 0];

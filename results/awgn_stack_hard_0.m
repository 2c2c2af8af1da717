% generated by convolutional_codes sweep runner
x_awgn_stack_hard_0 = [0 2 4 6 8 10 12 14];
awgn_stack_hard_0 = [0.441366 0.356209 0.162724 0.0317886 0.002244 3.96604e-05 1.29968e-07 0];
awgn_stack_hard_0_fer = [0.982137 0.850423 0.440877 0.0944531 0.00706862 0.000131039 3.99903e-07 0];

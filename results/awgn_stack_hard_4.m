% generated by convolutional_codes sweep runner
x_awgn_stack_hard_4 = [0 2 4 6 8 10 12 14];
awgn_stack_hard_4 = [0.36322 0.23533 0.0651245 0.00590503 0.000538305 4.3173e-05 1.75172e-06 1.9991e-08];
awgn_stack_hard_4_fer = [0.989624 0.826172 0.29303 0.0294617 0.00263261 0.000209263 8.74608e-06 6.2472e-08];

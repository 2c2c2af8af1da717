% generated by convolutional_codes sweep runner
x_awgn_stack_soft_5 = [0 2 4 6 8 10 12 14];
awgn_stack_soft_5 = [0.207496 0.0970703 0.0235229 0.00218091 0.000119679 4.42193e-06 4.24897e-08 0];
awgn_stack_soft_5_fer = [0.975789 0.806803 0.367961 0.05854 0.00441895 0.000171895 1.6496e-06 0];

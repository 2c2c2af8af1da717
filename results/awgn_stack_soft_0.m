% generated by convolutional_codes sweep runner
x_awgn_stack_soft_0 = [0 2 4 6 8 10 12 14];
awgn_stack_soft_0 = [0.454177 0.343024 0.109235 0.00676147 0.000124238 8.34562e-07 0 0];
awgn_stack_soft_0_fer = [0.975179 0.752726 0.234538 0.0142578 0.000269053 1.49474e-06 0 0];

% generated by convolutional_codes sweep runner
x_awgn_stack_soft_2 = [0 2 4 6 8 10 12 14];
awgn_stack_soft_2 = [0.26123 0.12007 0.0228027 0.00131738 5.47822e-05 2.87737e-06 1.11223e-07 2.49939e-09];
awgn_stack_soft_2_fer = [0.974162 0.749268 0.241943 0.0218945 0.00128846 7.77264e-05 3.09925e-06 4.99878e-08];

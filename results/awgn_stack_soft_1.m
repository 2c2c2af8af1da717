% generated by convolutional_codes sweep runner
x_awgn_stack_soft_1 = [0 2 4 6 8 10 12 14];
awgn_stack_soft_1 = [0.238844 0.112564 0.0226664 0.00137524 8.88996e-05 7.17474e-06 2.64936e-07 2.49939e-09];
awgn_stack_soft_1_fer = [0.975586 0.764526 0.249146 0.022627 0.00195512 0.000168905 6.24848e-06 9.99757e-08];

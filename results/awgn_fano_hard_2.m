% generated by convolutional_codes sweep runner
x_awgn_fano_hard_2 = [0 2 4 6 8 10 12 14];
awgn_fano_hard_2 = [0.345052 0.171106 0.042747 0.0072334 0.000950878 8.99459e-05 3.84282e-06 2.74933e-08];
awgn_fano_hard_2_fer = [0.974325 0.81014 0.41158 0.111421 0.0182423 0.00186195 8.00305e-05 6.9983e-07];

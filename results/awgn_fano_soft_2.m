% generated by convolutional_codes sweep runner
x_awgn_fano_soft_2 = [0 2 4 6 8 10 12 14];
awgn_fano_soft_2 = [0.445753 0.308564 0.0273285 0.000771606 5.80706e-05 2.88983e-06 1.11223e-07 2.49939e-09];
awgn_fano_soft_2_fer = [0.995076 0.784871 0.148153 0.0151611 0.00134825 7.87229e-05 3.09925e-06 4.99878e-08];

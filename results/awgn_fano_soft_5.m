% generated by convolutional_codes sweep runner
x_awgn_fano_soft_5 = [0 2 4 6 8 10 12 14];
awgn_fano_soft_5 = [0.455017 0.327146 0.0391602 0.00127637 0.000123403 4.8579e-06 5.12375e-08 0];
awgn_fano_soft_5_fer = [0.996826 0.825928 0.243286 0.0420312 0.00456593 0.000187341 1.99951e-06 0];

% generated by convolutional_codes sweep runner
x_uncoded_3bit_argmin = [0 2 4 6 8 10 12 14];
uncoded_3bit_argmin = [0.128288 0.079642 0.0413106 0.0160577 0.00406945 0.000521853 2.2737e-05 1.84864e-07];
uncoded_3bit_argmin_fer = [0.31929 0.209805 0.114552 0.0464214 0.0120764 0.00156298 6.82111e-05 5.54593e-07];

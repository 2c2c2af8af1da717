% generated by convolutional_codes sweep runner
x_uncoded_2bit_argmin = [0 2 4 6 8 10 12 14];
uncoded_2bit_argmin = [0.0785799 0.0372982 0.0123587 0.00239825 0.00019263 3.7773e-06 0 0];
uncoded_2bit_argmin_fer = [0.150974 0.0731716 0.0245705 0.00479174 0.000385135 7.5546e-06 0 0];

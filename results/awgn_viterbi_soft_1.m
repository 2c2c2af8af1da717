% generated by convolutional_codes sweep runner
x_awgn_viterbi_soft_1 = [0 2 4 6 8 10 12 14];
awgn_viterbi_soft_1 = [0.146736 0.0517501 0.0095212 0.00104017 9.25064e-05 6.69956e-06 2.77433e-07 0];
awgn_viterbi_soft_1_fer = [0.868961 0.502857 0.136536 0.0191116 0.00202656 0.000169754 7.33215e-06 0];

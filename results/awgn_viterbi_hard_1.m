% generated by convolutional_codes sweep runner
x_awgn_viterbi_hard_1 = [0 2 4 6 8 10 12 14];
awgn_viterbi_hard_1 = [0.233927 0.123956 0.0407531 0.00738649 0.000817037 6.66618e-05 2.74088e-06 1.73395e-08];
awgn_viterbi_hard_1_fer = [0.971588 0.808895 0.422195 0.105717 0.0138855 0.0012269 5.05819e-05 2.47708e-07];

% generated by convolutional_codes sweep runner
x_awgn_stack_hard_2 = [0 2 4 6 8 10 12 14];
awgn_stack_hard_2 = [0.287341 0.163815 0.0512868 0.00786902 0.000942146 9.00082e-05 3.84282e-06 2.74933e-08];
awgn_stack_hard_2_fer = [0.981812 0.849731 0.454631 0.114272 0.018042 0.00186045 8.00305e-05 6.9983e-07];

#!/bin/sh
# Ours-side runs of the round-3 ++ high-dim head-to-head (VERDICT r2
# item 5). Mirrors the reference runs in /tmp/h2h/ref_*.log (launched
# from the same configs); compare with scripts/h2h_compare.py.
# Runs on whatever backend JAX picks (intended: the GPU).
set -x
O=${1:-/tmp/h2h}
D="--train_data /root/reference/tests/ml-1m/train.csv --test_train_data /root/reference/tests/ml-1m/validation_tr.csv --test_test_data /root/reference/tests/ml-1m/validation_te.csv --stdev 0.1 --epoch 50"
CLI="python -m safer2_recommender_tpu.cli"
$CLI --model_name safer2pp --dim 512 --uobs_weight 0.0004 --l2_reg 0.0012 --alpha 0.3 --bandwidth 0.1 --use_snr 1 --sampling_ratio 0.1 --pd_iterations 1 --xi_iterations 5 --block_size 64 $D > $O/ours_safer2pp_512.log 2>&1
$CLI --model_name ialspp --dim 512 --uobs_weight 0.05 --l2_reg 0.002 --block_size 64 $D > $O/ours_ialspp_512.log 2>&1
$CLI --model_name safer2pp --dim 256 --uobs_weight 0.002 --l2_reg 0.002 --alpha 0.3 --bandwidth 0.18 --use_snr 1 --sampling_ratio 0.1 --pd_iterations 1 --xi_iterations 5 --block_size 64 $D > $O/ours_safer2pp_256.log 2>&1
$CLI --model_name ialspp --dim 256 --uobs_weight 0.004 --l2_reg 0.002 --block_size 64 $D > $O/ours_ialspp_256.log 2>&1
$CLI --model_name erm_mf --dim 512 --uobs_weight 0.0004 --l2_reg 0.0012 --alpha 0.3 $D > $O/ours_erm_mf_512.log 2>&1
$CLI --model_name ials --dim 512 --uobs_weight 0.05 --l2_reg 0.002 $D > $O/ours_ials_512.log 2>&1
echo OURS_DONE > $O/OURS_DONE

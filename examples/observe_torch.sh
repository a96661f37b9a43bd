#!/usr/bin/env bash
# Example observation driver on the PyTorch/CUDA port (examples/observe.sh
# on python -m fxtpu_torch): a 5-second spectrum observation over the
# default synthetic source, products and plot saved in the current
# directory.  The port runs on the card (--device cuda, the default);
# pass --device cpu to run it without one.
set -euo pipefail

python -m fxtpu_torch \
    --time 5 \
    --mode spectrum \
    --bandwidth 2.4e6 \
    --frequency 1.4204e9 \
    --num_samp 262144 \
    --resolution 4096 \
    --gain 49.6 \
    --true_delay 2e-6 \
    --no_keyboard \
    --output visibilities_example.csv \
    --save_plot visibilities_example.png \
    -L INFO \
    "$@"   # extra/override flags (argparse last-wins), e.g. --device cpu

echo "products: visibilities_example.csv / visibilities_example.png"

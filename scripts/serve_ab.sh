#!/bin/sh
# Serve one synthetic trace through the port's serving CLI
# (`python -m repro_torch.launch.serve --engine --sparse`) from several
# checkouts of the repo, in the order given, on one card, so that two
# versions are compared within one machine session (host time varies
# between sessions far more than between turns of one session).
#
#   scripts/serve_ab.sh "CLI ARGS" LABEL=DIR [LABEL=DIR ...]
#
# e.g. with the parent commit unpacked into build/ab_parent:
#   scripts/serve_ab.sh "--arch bert-base-sten --nm 1:4:8" \
#       parent=build/ab_parent change=. change=. parent=build/ab_parent
#
# Prints the card's name and power limit, then for each turn its label
# and the CLI's per-token latency lines (dense, sparse, their p50 ratio).
set -e
args=$1
shift
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for turn in "$@"; do
    label=${turn%%=*}
    dir=${turn#*=}
    echo "== $label ($dir): $args"
    (cd "$dir" && PYTHONPATH=src python -m repro_torch.launch.serve \
        --engine --sparse $args) | grep -E "per-token|served"
done

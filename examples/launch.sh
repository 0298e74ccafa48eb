#!/usr/bin/env bash
# Training launch (the reference's single-GPU job.sbatch:1-12 counterpart).
#
# One host: one process drives every card. Add
#   "dist": {"mesh": {"data": -1}}
# to args.json so the batch data-parallelizes over all cards of the host
# (batch_size must divide by the card count), then run
#   bash examples/launch.sh args.json
#
# Several hosts: run the same command once per host with the coordinator
# given explicitly (cdlnet_tpu.dist.initialize_distributed reads these):
#   export COORDINATOR_ADDRESS=host0:8476
#   export NUM_PROCESSES=2
#   export PROCESS_ID=0                    # 0..NUM_PROCESSES-1
set -euo pipefail
ARGS_JSON=${1:?usage: launch.sh args.json}
python - "$ARGS_JSON" <<'PY'
import json, sys
from cdlnet_tpu.dist import initialize_distributed
initialize_distributed()
from cdlnet_tpu.cli.train import main
main(json.load(open(sys.argv[1])))
PY

#!/usr/bin/env bash
# Build + run the evaluation harness in the deployment container.
# (The reference's deploy/start.sh + docker-compose equivalent; the GPUs
# reach the container through the NVIDIA container toolkit.)
set -euo pipefail
cd "$(dirname "$0")/.."

IMAGE=mcmh-localization
docker build -f deploy/Dockerfile -t "$IMAGE" .
docker run --rm --gpus all \
    -v "$(pwd)/results:/opt/mcmh/results" \
    "$IMAGE" "$@"

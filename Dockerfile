# Containerized run environment for dynode_tpu.
#
# The reference ships a CPU container (reference: Dockerfile:1, python:3.10 +
# poetry + /input and /output experiment mounts). This image keeps the same
# mount contract but installs JAX with its CUDA plugin: run it with the
# NVIDIA container runtime so JAX sees the cards.
#
# Build:  docker build -t dynode .
# Run:    docker run --gpus all \
#           -v "$PWD/experiment:/input" -v "$PWD/results:/output" \
#           -v "$PWD/jax_cache:/cache" dynode python /input/run.py

FROM python:3.12-slim

# experiment-definition mount (read) and results mount (write)
RUN mkdir /input /output /app
WORKDIR /app

# install the framework itself (wheel ships dynode_tpu + the `dynode`
# compatibility alias); jax[cuda12] brings the CUDA plugin and libraries
COPY pyproject.toml README.md LICENSE /app/
COPY dynode_tpu/ /app/dynode_tpu/
COPY dynode/ /app/dynode/
RUN pip install --no-cache-dir "jax[cuda12]" \
 && pip install --no-cache-dir /app

# persistent XLA compile cache across container runs (mount a volume over
# /cache to keep it); JAX reads this variable itself, and
# dynode_tpu.enable_compilation_cache uses it when it is set
ENV JAX_COMPILATION_CACHE_DIR=/cache
RUN mkdir /cache

CMD ["python", "-c", "import dynode_tpu, jax; print(dynode_tpu.__version__, jax.devices())"]

# uvaia-tpu container (packaging parity with the reference's
# Dockerfile, which builds the C toolchain in a Debian base).
#
# The compute path runs on an NVIDIA GPU through the CUDA build of JAX
# (its wheels bring the CUDA libraries); run the image with
# `docker run --gpus all ...`.  Without a GPU, JAX falls back to the
# CPU, so `uvaia -h` and the CPU tests still work anywhere.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ \
        liblzma-dev \
        zlib1g-dev \
        libbz2-dev && \
    apt-get clean && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/uvaia-tpu
COPY pyproject.toml README.md chip_smoke.py ./
COPY uvaia_tpu ./uvaia_tpu

RUN pip install --no-cache-dir 'jax[cuda12]' numpy && \
    pip install --no-cache-dir . && \
    # pre-build the native IO library (io/native.py builds lazily on
    # first use otherwise)
    python -c "from uvaia_tpu.io.native import get_lib; assert get_lib() is not None"

# same smoke test the reference's bioconda recipe runs (meta.yaml:40-42)
RUN uvaia -h > /dev/null

ENTRYPOINT ["uvaia-tpu"]

# Deployment image (reference Dockerfile parity: python-slim + audio stack;
# GPU serving images inherit a CUDA-enabled JAX base instead).
FROM python:3.12-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends libportaudio2 \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY echoseal_tpu ./echoseal_tpu
RUN pip install --no-cache-dir ".[audio]"

# live TX needs the host's sound device: docker run --device /dev/snd ...
ENTRYPOINT ["echoseal-tx"]

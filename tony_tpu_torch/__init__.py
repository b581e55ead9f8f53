"""tony-tpu's training path in PyTorch and CUDA, for NVIDIA Hopper.

A port of ``tony_tpu``'s training steps: the flagship decoder, ResNet and
the MNIST MLP (``models``); flash attention and the fused GroupNorm→ReLU,
each with hand-written CUDA kernels for ``sm_90a`` (``ops``, sources in
``csrc/``); the single-device train step with AdamW and SGD
(``parallel``); deterministic synthetic batches (``data``); weight
conversion from the flax trees (``convert``) and the trainers
(``trainer``). It imports ``torch`` and numpy and nothing of JAX or of
``tony_tpu``. Entry points run on ``device="cuda"`` and raise without a
CUDA device unless ``"cpu"`` is asked for.
"""

__version__ = "0.1.0"

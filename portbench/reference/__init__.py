"""Plain PyTorch references of what the timed paths compute.

Written from the published descriptions (Kaldi fbank, librosa log-mel,
MViTv2 as MAST, AST, MoCo's InfoNCE with a queue, Adam and AdamW), in float32
with TF32 off unless a ``Precision`` says otherwise. Weights are plain dicts
of tensors under the port's parameter names, which the benchmark makes from
the seed and hands to both sides. Nothing here imports the port.
"""

"""LM scaffold in PyTorch: every architecture family of ``configs.ARCHS``
(dense, MoE, RWKV-6, hybrid SSM, encoder, VLM), trained (loss, train
step) and served (prefill, decode) on one device or, with `mesh=`, as
DTensors on a torch DeviceMesh."""
from . import transformer, nn_ops, moe, rwkv6, ssm, param, api, convert
from .api import (make_loss_fn, make_train_step, make_prefill_fn,
                  make_decode_fn, init_model,
                  concrete_batch, decode_cache_len, cast_params, DECODE_PAD)
from .convert import params_from_reference, cache_to_numpy, cache_from_numpy

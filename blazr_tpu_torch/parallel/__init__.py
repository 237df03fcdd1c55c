"""Tensor, expert and sequence parallelism over ``torch.distributed``.

Counterpart of ``blazr_tpu/parallel``: ``mesh`` (the rank mesh),
``multihost`` (process bring-up and the local launcher), ``comm`` (the
collectives and the backend rule), ``tp`` (each rank's slice of the
weights), ``ep`` (capacity dispatch and the expert-parallel MoE FFN) and
``ring_attention`` (sequence-parallel prefill). Import the submodules
themselves: this package imports nothing at load, so that the model code can
use ``comm`` without a cycle.
"""

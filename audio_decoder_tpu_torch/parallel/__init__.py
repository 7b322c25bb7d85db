"""Decode steps on one device and sharded over a ``('data', 'model')``
mesh; the voice-sharded render; the multi-device dry run."""
from .mesh import (Mesh, Replicated, Sharded, make_mesh, pad_to_multiple,
                   psum, replicate, shard)
from .decode import (decode_pcm_step, pad_batch, round_sizing,
                     sharded_decode_fn, sharded_flac_fn, sharded_l12_fn,
                     sharded_mp3_decode_fn)
from .render import (ShardedEngine, shard_engine_state, sharded_render_fn,
                     state_shardings)
from .dryrun import dryrun_multichip

__all__ = [
    "Mesh", "Sharded", "Replicated", "make_mesh", "pad_to_multiple", "shard",
    "replicate", "psum", "decode_pcm_step", "pad_batch", "round_sizing",
    "sharded_decode_fn", "sharded_mp3_decode_fn", "sharded_l12_fn",
    "sharded_flac_fn", "ShardedEngine", "state_shardings",
    "shard_engine_state", "sharded_render_fn", "dryrun_multichip",
]

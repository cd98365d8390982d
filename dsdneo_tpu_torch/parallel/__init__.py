"""Multi-GPU scaling over ``torch.distributed``: the channel-sharded
steps of every family, closed-loop trunking of S systems sharded over
the ranks, and the ``dryrun_multichip`` contract (counterpart of
``dsdneo_tpu/parallel``)."""

from dsdneo_tpu_torch.parallel.mesh import (dryrun_multichip,
                                            make_sharded_dmr_voice_step,
                                            make_sharded_frontend,
                                            make_sharded_p2_voice_step,
                                            make_sharded_p25_cc_step,
                                            make_sharded_trunk_step,
                                            make_sharded_voice_step)

__all__ = ["make_sharded_frontend", "make_sharded_voice_step",
           "make_sharded_dmr_voice_step", "make_sharded_p2_voice_step",
           "make_sharded_p25_cc_step", "make_sharded_trunk_step",
           "dryrun_multichip"]

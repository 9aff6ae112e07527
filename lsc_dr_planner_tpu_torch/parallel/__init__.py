"""Multi-device planning over torch.distributed (port of
lsc_dr_planner_tpu/parallel): the fleet's agents split over the ranks of
a process group, one rank per device (NCCL on the card, gloo on the
CPU). Each rank plans its contiguous block of agents with the step's
neighbour override; the neighbour candidates come from an all-gather
of the whole fleet (mesh.py) or from the ±h neighbouring blocks of a
spatially sorted fleet (halo.py). scaling.py times the sharded step.
"""

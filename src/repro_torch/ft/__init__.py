"""Fault tolerance (the port of ``repro/ft``): straggler policies, elastic
pod scaling, the membership table, chaos injection and the preemption
watchdog."""
from repro_torch.ft.chaos import ChaosClock, ChaosSpec
from repro_torch.ft.elastic_scale import (pod_join, pod_join_rows, pod_leave,
                                          pod_leave_rows, rescale_pods)
from repro_torch.ft.membership import MembershipTable
from repro_torch.ft.straggler import (BoundedStaleness, StragglerPolicy,
                                      masked_center_mean)
from repro_torch.ft.watchdog import Watchdog

__all__ = ["BoundedStaleness", "ChaosClock", "ChaosSpec", "MembershipTable",
           "StragglerPolicy", "Watchdog", "masked_center_mean", "pod_join",
           "pod_join_rows", "pod_leave", "pod_leave_rows", "rescale_pods"]

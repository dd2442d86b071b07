from repro_torch.core.dispatch import (DISPATCH_POLICIES, DecodeLoad, DispatchPolicy,
                                 InstanceLoad, make_dispatch,
                                 plan_decode_migrations)
from repro_torch.core.events import Event, EventKind, EventMonitor
from repro_torch.core.metrics import (attainment_by_task, max_goodput, min_slo_scale,
                                percentile_goodput, percentile_report,
                                slo_attainment, slo_frac_percentile,
                                tbt_stats, ttft_stats)
from repro_torch.core.predictor import (DecodeStepPredictor, OnlineTTFTPredictor,
                                  TTFTPredictor)
from repro_torch.core.preemption import BlockingStats, PreemptionSignal, SyncCounter
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import (Action, Decision, DecodeEntry,
                                  DecodeSchedulerCore, HybridSchedulerCore,
                                  HybridStepPlan, PrefillSlice, SchedulerCore,
                                  decode_sedf_priority, slo_aware_batching)

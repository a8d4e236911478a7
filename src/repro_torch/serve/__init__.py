"""Serving: the paged continuous-batching engine, its page bookkeeping,
token selection (greedy or sampled with JAX's threefry keys), the
scheduler with preemption and the host swap tier, the chaos harness, the
cluster front end and disaggregated pools over engine replicas, and
open-loop traffic."""
from repro_torch.serve.chaos import (ChaosConfig, ChaosEngine,  # noqa: F401
                                     ClusterChaos, ClusterChaosConfig,
                                     DisaggChaos, DisaggChaosConfig,
                                     fault_rng)
from repro_torch.serve.cluster import (ClusterConfig,  # noqa: F401
                                       ClusterFrontEnd, ClusterStats,
                                       DisaggConfig, DisaggPool, DisaggStats,
                                       Replica, TransientAdmitError,
                                       aggregate_stats)
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: F401
from repro_torch.serve.hosttier import (HostKVEntry, HostKVTier,  # noqa: F401
                                        corrupt_entry, make_transfer_entry)
from repro_torch.serve.kvcache import (PageAllocator, PoolExhausted,  # noqa: F401
                                       PrefixIndex, page_hashes)
from repro_torch.serve.sampling import (GREEDY, SamplingParams,  # noqa: F401
                                        mask_logits, sample_token,
                                        sample_tokens)
from repro_torch.serve.scheduler import (PRIORITY_HIGH,  # noqa: F401
                                         PRIORITY_LOW, Scheduler,
                                         SchedulerConfig, SwapCostModel)
from repro_torch.serve.traffic import TrafficConfig, generate_traffic  # noqa: F401

"""Streaming continual training: incremental DTI over growing histories
(counterpart of ``repro.stream``).

Closes the train->serve loop: events -> incremental prompt construction
(``incremental``) -> async fixed-shape batching (``pipeline``) -> online
fine-tuning with streaming eval (``online``) -> weight publication into
the live serving fleet (``publish``) -> hot-user prefix prewarming of the
serving fleet's paged KV cache (``prewarm``); ``shard`` fans one stream
over user-disjoint shards and merges their metrics.
"""
from repro_torch.stream.incremental import IncrementalDTI
from repro_torch.stream.online import (EvalWindow, OnlineTrainer,
                                       make_stream_loss_fn)
from repro_torch.stream.pipeline import StreamPipeline
from repro_torch.stream.prewarm import PrefixPrewarmer
from repro_torch.stream.publish import (LocalDirStore, ObjectStore,
                                        ParamPublisher, ParamSubscriber,
                                        replicated_subscribers)
from repro_torch.stream.shard import (fleet_eval, fleet_serve_snapshot,
                                      merged_streaming_auc,
                                      merged_streaming_log_loss,
                                      shard_events)

__all__ = ["IncrementalDTI", "StreamPipeline", "OnlineTrainer", "EvalWindow",
           "make_stream_loss_fn", "ParamPublisher", "ParamSubscriber",
           "ObjectStore", "LocalDirStore", "replicated_subscribers",
           "shard_events", "merged_streaming_auc", "merged_streaming_log_loss",
           "fleet_eval", "fleet_serve_snapshot",
           "PrefixPrewarmer"]

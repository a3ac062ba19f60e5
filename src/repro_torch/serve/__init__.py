"""The serving stack (twin of ``repro.serve``): the continuous-batching
engine, AOT buckets, the serve journal and the async host pipeline."""
from repro_torch.serve.aot import BucketTable  # noqa: F401
from repro_torch.serve.engine import (Rejected, Request,  # noqa: F401
                                      ServeEngine, make_serve_step)
from repro_torch.serve.journal import (ReplayState,  # noqa: F401
                                       ServeJournal, ServeJournalCorrupt,
                                       load_requests)
from repro_torch.serve.pipeline import HostPipeline  # noqa: F401

"""repro_torch.core — the paper's MPIX extensions on PyTorch/CUDA.

1. generalized requests + poll/wait  → :mod:`repro_torch.core.progress`
2. datatype iovec                    → :mod:`repro_torch.core.datatype`
3. MPIX streams                      → :mod:`repro_torch.core.streams`
4. enqueue (device-ordered) ops      → :mod:`repro_torch.core.enqueue`
6. general progress                  → :mod:`repro_torch.core.progress`

plus recorded record-once/replay-many schedules
(:mod:`repro_torch.core.schedule`). Thread communicators (ext. 5), stream
communicators and the collective layer are not ported yet (ROADMAP).
"""

from repro_torch.core.datatype import (
    BF16,
    BYTE,
    DOUBLE,
    FLOAT,
    INT32,
    Datatype,
    Iov,
    coalesced_iovs,
    contiguous,
    hindexed,
    hvector,
    indexed,
    iter_runs,
    make_packer,
    pack,
    pack_info,
    pack_naive,
    predefined,
    resized,
    struct,
    subarray,
    type_extent,
    type_iov,
    type_iov_len,
    type_size,
    unpack,
    unpack_naive,
    vector,
)
from repro_torch.core.enqueue import (
    EnqueuedRequest,
    OffloadWindow,
    WindowSlot,
    dispatch_enqueue,
    pack_send,
    wait_enqueue,
)
from repro_torch.core.progress import (
    AutotunePolicy,
    Autotuner,
    FusedRequestSet,
    GeneralizedRequest,
    ProgressEngine,
    default_engine,
    grequest_complete,
    grequest_start,
    start_progress_thread,
    stop_progress_thread,
    stream_progress,
)
from repro_torch.core.schedule import (
    ReplayContext,
    Schedule,
    ScheduleError,
    ScheduleStale,
    ScheduleStateError,
)
from repro_torch.core.streams import (
    MPIXStream,
    STREAM_NULL,
    StreamPool,
    default_pool,
    info_set_hex,
    new_token,
    serialize_on,
    stream_create,
    stream_free,
    token_join,
)

"""repro_torch.core — the paper's MPIX extensions on PyTorch/CUDA.

1. generalized requests + poll/wait  → :mod:`repro_torch.core.progress`
2. datatype iovec                    → :mod:`repro_torch.core.datatype`
3. MPIX streams / stream comms       → :mod:`repro_torch.core.streams`
4. enqueue (device-ordered) ops      → :mod:`repro_torch.core.enqueue`
5. thread communicators              → :mod:`repro_torch.core.threadcomm`
6. general progress                  → :mod:`repro_torch.core.progress`

plus the device mesh whose positions are thread-ranks
(:mod:`repro_torch.core.mesh`), the stream-tagged collective layer
(:mod:`repro_torch.core.collectives`), hierarchical multi-pod schedules
(:mod:`repro_torch.core.hierarchical`), the host collectives over
thread-ranks (:mod:`repro_torch.core.threadcoll`) and recorded
record-once/replay-many schedules (:mod:`repro_torch.core.schedule`).
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
    isend_enqueue,
    isend_enqueue_scheduled,
    pack_send,
    send_enqueue,
    shift_enqueue,
    wait_enqueue,
)
from repro_torch.core.mesh import Mesh, P, make_mesh
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
    StreamComm,
    StreamPool,
    comm_get_stream,
    default_pool,
    info_set_hex,
    new_token,
    serialize_on,
    stream_comm_create,
    stream_comm_create_multiplex,
    stream_create,
    stream_free,
    token_join,
)
from repro_torch.core.threadcomm import (
    ANY_SOURCE,
    ANY_TAG,
    HostThreadComm,
    HybridThreadComm,
    RecvFuture,
    ThreadComm,
    ThreadRank,
    comm_test_threadcomm,
    flatten_comm,
    host_threadcomm_init,
    shard_map,
    split_comm,
    tc_recv,
    tc_send,
    threadcomm_free,
    threadcomm_init,
)
from repro_torch.core import threadcoll

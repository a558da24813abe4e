"""``test_torch_recurrent_paged.py``'s tests for recurrentgemma-9b (cut
to one (rglru, rglru, local) period and the 2-layer remainder, KV heads
of 128): its RG-LRU state and its LOCAL rings, which wrap at the cut's
32-slot window, rewound and committed together."""
import pytest

from test_torch_recurrent_paged import (  # noqa: F401
    test_degraded_container_refused, test_engine_without_paged_layers,
    test_forced_rejections_commit_the_verified_state,
    test_launch_serve_trace_on_cpu, test_paged_trace_matches_jax)


@pytest.fixture(params=["recurrentgemma-9b"])
def arch(request):
    return request.param

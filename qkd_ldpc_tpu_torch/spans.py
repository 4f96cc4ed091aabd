"""Host spans at the port's layer boundaries, recorded only while a torch
profiler is recording.

:func:`span` returns ``torch.autograd.profiler.record_function(name)`` while
a profiler records, and otherwise one shared no-op context, so with no
profiler a span costs one check of the profiler's flag.  The profiler is the
switch: an operator traces a running node as the benchmark does, with
``torch.profiler.profile``.  With CUDA activity traced, the profiler records
these ranges on the clock of the card's activity, so an idle stretch of the
device timeline can be named after the program's phase that the host was in.

A span is host-only: none sits inside a captured program's body.  Its parent
is the span around it on the same host thread (an endpoint serialises its
calls; a runner drives one device from one thread).  :data:`SPANS` names
every span with what it covers.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

SPANS = {
    # graph launches (decoder/device_loop.py)
    "qkd.graph.capture": "Graph.capture: the program's eager warm-up and its capture",
    "qkd.graph.replay": "Graph.replay: the graph's launch (cudaGraphLaunch)",
    # the point runner (sim/runner.py)
    "qkd.point.run": "run_point: a point's dispatch and the fetch of its statistics",
    "qkd.point.dispatch": "_dispatch_point: chunk inputs, programs, replays, queued host copies",
    "qkd.fetch.wait": "_HostCopy.get: the host waits for a queued copy from the card",
    # the continuation (sim/continuation.py)
    "qkd.cont.run": "run_point_continuation: a point's continuation call and its fetch",
    "qkd.cont.dispatch": "_continuation_core: inputs, program, replay and the queued copy",
    # the serving endpoint (serve.py)
    "qkd.serve.reconcile": "Reconciler.reconcile: one call, every chunk of it",
    "qkd.serve.syndromes": "Reconciler.syndromes: one call, every chunk of it",
    "qkd.serve.fill": "a chunk's rows into its pinned slot",
    "qkd.serve.dispatch": "_Runner.dispatch: copy in, program or replay, copy out, event",
    "qkd.serve.wait": "_Runner.fetch: the host waits for the slot's event",
    "qkd.serve.read": "a chunk's results out of its slot",
    # the secure chain (serve.py, Reconciler.reconcile_secure)
    "qkd.serve.secure": "Reconciler.reconcile_secure: one call, reconcile, tags and amplification",
    "qkd.secure.tags": "Bob's verification tags, their fetch and the comparison with Alice's",
    "qkd.secure.amplify": "the block's privacy amplification and the fetch of its keys",
    # blind reconciliation (serve.py, BlindRounds; the tags and amplification
    # of its finalize are qkd.secure.tags and qkd.secure.amplify)
    "qkd.blind.session": "a blind session's rounds: begin() to the end of its last round",
    "qkd.blind.round": "a blind round: its chunks' fills, dispatches and fetches",
    "qkd.blind.turn": "a round's end to the next round's start: the request and Alice's bits",
    "qkd.blind.reveal": "BlindRounds.run: the reveal callback (Alice's answer)",
    # the sweep runner (sim/runner.py, sim/csv_writer.py)
    "qkd.sweep.run": "batch_simulation: a whole sweep",
    "qkd.sweep.setup": "batch_simulation up to its first point: options, checkpoint, key, mesh",
    "qkd.sweep.checkpoint": "_append_checkpoint: one point's checkpoint line",
    "qkd.sweep.write": "write_results: the results CSV",
}

# The context every span returns while no profiler records: shared, reentrant.
OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` (one of :data:`SPANS`) while a profiler
    records, else the shared no-op :data:`OFF`."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return OFF

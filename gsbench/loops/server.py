"""Many remote viewers behind the render server, open loop: each request
submitted at its due time on the mix's Poisson schedule (``rate_hz``,
``gsbench/drive.py`` ``arrivals``), on the loop's own clock, while the loop
turns the server's scheduler (``server`` holds the ``RenderServer``
arguments). Set-up commits the scene and renders ``warm`` full dispatches.

The traced run: (a) ``profiled_seconds`` of the loop under torch.profiler,
for the device's idle share; (b) ``span_seconds`` with the program's tracer
on, for the ``serve/dispatch`` spans, each request's wait from its due time
to its dispatch, and the server's lane counters."""
from __future__ import annotations

import time
from typing import Dict, List

from gsbench import devtrace
from gsbench.drive import Sample, Window, arrivals, warm_azimuths
from gsbench.harness import rng


class Loop:
    def __init__(self, cell):
        from repro_torch.serving.server import RenderServer

        self.cell = cell
        self.scene_id = cell.config["name"]
        self.server = RenderServer({self.scene_id: cell.scene_p}, device=cell.device,
                                   **cell.traffic["server"])
        self.server.commit(self.scene_id, cell.cfg)
        azimuths = warm_azimuths(cell.seed)
        for _ in range(int(cell.traffic.get("warm", 3))):
            self._warm(azimuths)

    def _warm(self, azimuths) -> None:
        """One full dispatch: max_batch requests, bucketed, rendered,
        copied to the host."""
        from repro_torch.serving.queue import RenderRequest

        for i in range(self.server.scheduler.max_batch):
            self.server.submit(RenderRequest(request_id=-1 - i, scene_id=self.scene_id,
                                             camera=self.cell.cams(next(azimuths))[1],
                                             cfg=self.cell.cfg))
        self.server.drain()
        self.server.results.clear()

    def close(self) -> None:
        self.server.close()

    def window(self, seconds: float, salt: str = "") -> Window:
        """Submit each request at its due time on this loop's clock (the
        server's), turn the scheduler, and collect what completes until
        every request due is delivered or ``grace_s`` past the window's
        close. ``missing``: the requests never delivered."""
        from repro_torch.serving.queue import RenderRequest

        c = self.cell
        schedule = arrivals(c.traffic, c.seed, seconds, salt)
        k = min(c.check_k, len(schedule))
        check_ids = set(rng(c.seed, f"check{salt}").choice(len(schedule), size=k,
                                                           replace=False).tolist())
        grace_s = float(c.traffic.get("grace_s", 60.0))
        server = self.server
        clock = time.monotonic
        n = len(schedule)
        reqs: Dict[int, object] = {}
        done: Dict[int, float] = {}
        dispatched: Dict[int, float] = {}
        rejected = set()
        samples: List[Sample] = []
        poll = max(server.scheduler.max_wait, 1e-3) / 4
        start = clock()
        nxt = 0
        while True:
            now = clock() - start
            while nxt < n and schedule[nxt][0] <= now:
                due, az = schedule[nxt]
                _, cam = c.cams(az)
                req = RenderRequest(request_id=nxt, scene_id=self.scene_id, camera=cam,
                                    cfg=c.cfg)
                reqs[nxt] = req
                if not server.submit(req):
                    rejected.add(nxt)
                nxt += 1
            server.step()
            for rid in list(server.results):
                res = server.results.pop(rid)
                stamps = reqs[rid].stamps
                done[rid] = stamps["device_done"] - start
                dispatched[rid] = stamps["dispatch"] - start
                if rid in check_ids:
                    samples.append(Sample(rid, schedule[rid][1], res.image))
            settled = len(done) + len(rejected)
            now = clock() - start
            if nxt == n and settled == n:
                break
            if now > seconds + grace_s:
                break
            gap = (schedule[nxt][0] - now) if nxt < n else poll
            if gap > 0:
                time.sleep(min(gap, poll))
        latency, queue = [], []
        for rid, (due, _) in enumerate(schedule):
            if rid in done:
                latency.append(done[rid] - due)
                queue.append(dispatched[rid] - due)
            else:
                latency.append(float("inf"))
        return Window(latency_s=latency, span_s=clock() - start,
                      samples=sorted(samples, key=lambda s: s.index),
                      readings={"missing": n - len(done)}, queue_s=queue)

    def trace(self, td) -> Window:
        from repro_torch.obs import get_tracer

        t = self.cell.traffic["trace"]
        holder = {}

        def part_a(annotate):
            with annotate("gsbench/window"):
                holder["w"] = self.window(float(t["profiled_seconds"]), "trace-a")

        td.events = devtrace.run_profiled(part_a)
        td.ops = devtrace.device_ops(td.events)
        ((td.w0, td.w1, _),) = devtrace.annotations(td.events, "gsbench/window")
        td.busy_s, td.window_s = devtrace.busy(td.ops, td.w0, td.w1), td.w1 - td.w0

        tracer = get_tracer()
        tracer.clear()
        tracer.enable()
        before = self.server.stats.summary()
        w = self.window(float(t["span_seconds"]), "trace-b")
        after = self.server.stats.summary()
        tracer.disable()
        td.dispatch_s = [e.duration_s for e in tracer.events() if e.name == "serve/dispatch"]
        td.queue_s = list(w.queue_s)
        td.lanes = {k: after[k] - before[k] for k in ("completed", "padded", "batches")}
        a = holder["w"]
        return Window(latency_s=a.latency_s + w.latency_s, span_s=a.span_s + w.span_s,
                      samples=w.samples,
                      readings={"missing": a.readings["missing"] + w.readings["missing"]})

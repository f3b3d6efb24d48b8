"""Closed loop, one request a video: `SelectionEngine.select` on the next
video of the pool with the next instruction (upload from pageable memory,
resize, tower, projector, LM, head, scores back on the host)."""

from __future__ import annotations

from benchmark.requests import Request


class Client:
    def __init__(self, engine, traffic):
        self.engine, self.traffic = engine, traffic
        self.k = 0

    def _run(self, video: int, instruction: str):
        frames = self.traffic.videos[video]
        return self.engine.select(frames, list(range(frames.shape[0])), instruction).raw_scores

    def warm(self) -> None:
        """The one shape the window uses: a whole request."""
        self._run(0, self.traffic.instructions[-1])

    def next(self) -> Request:
        t = self.traffic
        video, instruction = self.k % len(t.videos), t.instructions[self.k % len(t.instructions)]
        self.k += 1
        scores = self._run(video, instruction)
        return Request(video=video, group=self.k - 1, instruction=instruction,
                       frames=t.videos[video].shape[0], questions=1, encoded=True,
                       scores=scores)

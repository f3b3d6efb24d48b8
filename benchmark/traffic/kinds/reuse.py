"""Closed loop over videos asked several questions each: `encode_video`
once a video (upload, resize, tower), then one `score_encoded` call a
question (projector, LM, head). A request is one question; the first
question of a video carries its encoding."""

from __future__ import annotations

from benchmark.requests import Request


class Client:
    def __init__(self, engine, traffic):
        self.engine, self.traffic = engine, traffic
        self.per_video = traffic.mix["questions_per_video"]
        self.k = 0
        self.enc = None

    def warm(self) -> None:
        """Both calls of the window, at its shapes."""
        t = self.traffic
        enc = self.engine.encode_video(t.videos[0])
        self.engine.score_encoded(enc, [t.instructions[-1]])

    def next(self) -> Request:
        t = self.traffic
        group, j = divmod(self.k, self.per_video)
        video = group % len(t.videos)
        instruction = t.instructions[self.k % len(t.instructions)]
        self.k += 1
        if j == 0:
            self.enc = None
            self.enc = self.engine.encode_video(t.videos[video])
        scores = self.engine.score_encoded(self.enc, [instruction])[0]
        return Request(video=video, group=group, instruction=instruction,
                       frames=t.videos[video].shape[0], questions=1, encoded=j == 0,
                       scores=scores)

"""Session kind `batched`: `drives` drives at once through
`BatchedRunner.add_frames` ("deferred": frame i's keyframe subset runs in
the call of frame i + 1, before that frame's track)."""

import torch

from benchmark.harness.drivers import DriveSession


class Session(DriveSession):
    layer = "batched"

    def _stage(self):
        # (drives, N, H, W): a frame of every drive is one slice
        self.L = torch.stack([d.lefts for d in self.drives])
        self.R = torch.stack([d.rights for d in self.drives])
        for k, d in enumerate(self.drives):
            d.lefts, d.rights = self.L[k], self.R[k]
        self.runners = []

    def _start(self):
        from stereo_dso_g2o_tpu_torch.parallel.batched import BatchedRunner

        super()._start()
        self.runner = BatchedRunner(self.gss)
        self.runners.append(self.runner)
        self.runner.warm_kf_buckets((self.L[:, self.boot], self.R[:, self.boot]))

    def _submit(self, i):
        self.runner.add_frames((self.L[:, i], self.R[:, i]), i, timestamp=self.period * i)

    def _flush(self):
        self.runner.flush()

    def _windows(self):
        from stereo_dso_g2o_tpu_torch.utils.tree import tree_map

        # each drive's window is its row of the runner's stacked state
        return [(r, k, gs, tree_map(lambda x, k=k: x[k], self.runners[r].states.win))
                for r, gss in enumerate(self.runs) for k, gs in enumerate(gss)]

    def label_calls(self):
        kf = set()
        for r, gss in enumerate(self.runs):
            for gs in gss:
                kf.update((r, sh.id + 1) for sh in gs.history if sh.is_kf)
        self._kf = kf

    def is_kf_call(self, keys):
        r, _, i = keys[0]
        return (r, i) in self._kf

"""Session kind `graph`: one drive in a closed loop through
`GraphSystem.add_frame`, one captured program a frame; a frame's pose
reaches the host `fetch_lag` calls after its own."""

from benchmark.harness.drivers import DriveSession


class Session(DriveSession):
    layer = "graph"

    def _submit(self, i):
        d = self.drives[0]
        self.gss[0].add_frame(d.lefts[i], d.rights[i], i, timestamp=self.period * i)

    def _flush(self):
        self.gss[0].flush()

    def _windows(self):
        return [(r, 0, gss[0], gss[0].state.win) for r, gss in enumerate(self.runs)]

    def label_calls(self):
        self._kf = {(r, 0, sh.id) for r, gss in enumerate(self.runs) for sh in gss[0].history
                    if sh.is_kf}

    def is_kf_call(self, keys):
        return keys[0] in self._kf

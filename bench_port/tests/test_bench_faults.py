"""The check catches a broken timed path: the harness's run at the tiny
size on the CPU, with the program's step broken underneath the
recording once set-up is done, must come out not correct.  The faults a
cell of this benchmark can have: a step that returns its state
unchanged; half of each scan left out; the window's poses moved by 5 cm
where the step produces them (the loop mix's limit on them is 2 cm); the
submap solve's keyframe poses written back unmoved; the new keyframe's
normals altered where K5 produces them.  A one-chip cell has no exchange
between chips to leave out.  The checked step (scan 15 of the tiny
stream) adds a keyframe and runs the submap solve."""

import pytest

from bench_port import harness
from bench_port.tests import tiny


def _unchanged(state, pack, aux, prio, step):
    return state


def _half_scan(state, pack, aux, prio, step):
    aux = aux.clone()
    aux[-1, 4] = (aux[-1, 4] / 2).floor()  # the scan's point count: the second half is left out
    return step(state, pack, aux, prio)


def _pose_altered(state, pack, aux, prio, step):
    out = step(state, pack, aux, prio)
    return out._replace(ow_transl=out.ow_transl + 0.05)


def _normals_altered(state, pack, aux, prio, step):
    out = step(state, pack, aux, prio)
    if int(out.kf.num_updates) == int(state.kf.num_updates):
        return out
    slot = int(out.kf.count) - 1
    normals = out.kf.local_normals.clone()
    normals[slot] = normals[slot].roll(1, dims=1)  # (x, y, z) -> (z, x, y)
    return out._replace(kf=out.kf._replace(local_normals=normals))


FAULTS = {"unchanged_state": _unchanged, "half_scan": _half_scan, "pose_altered": _pose_altered,
          "normals_altered": _normals_altered}


def breaker(fn):
    def fault(slam):
        step = slam.step
        armed = []

        def broken(state, pack, aux, prio):
            if armed:
                return fn(state, pack, aux, prio, step)
            return step(state, pack, aux, prio)

        slam.step = broken
        return lambda: armed.append(True)

    return fault


# the number each fault has to fail
CAUGHT_BY = {"unchanged_state": "ring", "half_scan": "ring", "pose_altered": "window_m",
             "normals_altered": "normals", "keyframes_unmoved": "keyframe_m"}


def keyframes_unmoved(monkeypatch):
    """The submap solve's result written back unmoved: the program's
    write-back returns the keyframes as they were."""
    from dmsa_lidar_slam_tpu_torch.map import device_map

    def fault(slam):
        return lambda: monkeypatch.setattr(device_map, "write_back_capped", lambda kf, from_id, params: kf)

    return fault


def _loaded(root):
    return tiny.loaded(root, warmup=15, segment=(15, 17))


@pytest.mark.parametrize("name", sorted(FAULTS) + ["keyframes_unmoved"])
def test_fault_is_not_correct(root, name, monkeypatch):
    fault = keyframes_unmoved(monkeypatch) if name == "keyframes_unmoved" else breaker(FAULTS[name])
    result, extras = harness.run_cell(root, "nc_os128.loop", 4242, 1e-3, 0, device="cpu", loaded=_loaded(root),
                                      fault=fault)
    assert ["1", "15"] in extras["checked_steps"]
    assert not result["correct"], (name, extras["numbers"])
    failed = {k for k, v, lim in result["checks"] if not v <= lim}
    assert CAUGHT_BY[name] in failed, (name, result["checks"])


def test_the_faulted_step_is_sound_unbroken(root):
    """The same run with nothing broken is correct, so each fault above is
    what the check catches."""
    result, extras = harness.run_cell(root, "nc_os128.loop", 4242, 1e-3, 0, device="cpu", loaded=_loaded(root))
    assert ["1", "15"] in extras["checked_steps"]
    assert result["correct"], (result["checks"], extras["numbers"])

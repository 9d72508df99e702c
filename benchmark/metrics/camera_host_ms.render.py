"""Host ms a render call in the camera (`ops/camera.clip_space_transforms`:
`look_at` with its two checks, `perspective`; the program's `mr.camera`
span)."""

from benchmark import program


def read(ctx):
    return program.render_ms_per_call(program.span_table(), "mr.camera")

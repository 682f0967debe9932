"""loader_cpu_ms_per_img.train: the decode threads' CPU seconds reading and
weak-augmenting images (the program's `loader_cpu_time`, from its
`ubt.loader.read` and `ubt.loader.augment` spans) over the images they made
(`loader_images`), summed over the window, ms an image. None where the
program counts neither, or no image was made."""


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("loader_cpu_time" not in s or "loader_images" not in s for s in scalars):
        return None
    images = sum(s["loader_images"] for s in scalars)
    if images <= 0:
        return None
    return 1e3 * sum(s["loader_cpu_time"] for s in scalars) / images

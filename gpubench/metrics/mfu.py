"""``mfu.<cell>``: the FLOPs of the measured window's completed work
(``gpubench/flops/<configuration>.py``'s ``per_unit``, from the published
shapes) over the window's length times the card's bf16 peak, in
percent."""

from gpubench.peaks import peak


def read(ctx, metric):
    w = ctx.window
    if w.elapsed_s <= 0:
        return None
    flops = ctx.manifest.flops(ctx.cell.config_entry["name"])
    per = flops.per_unit(ctx.cell.config, ctx.cell.traffic)
    rate = per * w.units_done / w.elapsed_s
    return 100.0 * rate / peak(ctx.card.get("kind", ""))["bf16_flops"]

"""Tk + matplotlib view for pintk (reference: pint.pintk.plk/paredit).

Counterpart of ``pint_tpu.pintk.app``. A thin layer: every callback
delegates to :class:`pint_tpu_torch.pintk.controller.PintkController`;
no numerics live here. Tk and matplotlib are imported when the app
runs, never when the module is imported. Layout mirrors the reference's plk screen: residual plot with
error bars (prefit grey / postfit color), rubber-band box selection,
an x-axis selector, a parameter panel with fit checkboxes, and the
Fit / Reset / Random models / Write par / Write tim button row.
"""

from __future__ import annotations

import numpy as np


def run_app(ctrl) -> int:
    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    import matplotlib
    matplotlib.use("TkAgg")
    from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
    from matplotlib.figure import Figure
    from matplotlib.widgets import RectangleSelector

    from pint_tpu_torch.pintk.controller import X_AXES

    root = tk.Tk()
    root.title(f"pintk — {ctrl.model.name}")
    root.geometry("1100x700")

    fig = Figure(figsize=(8, 5), dpi=100)
    ax = fig.add_subplot(111)
    canvas = FigureCanvasTkAgg(fig, master=root)

    status = tk.StringVar(value=ctrl.summary())
    xaxis = tk.StringVar(value="mjd")
    show_random = tk.BooleanVar(value=False)
    show_avg = tk.BooleanVar(value=False)

    # ---------------------------------------------------------------- params
    side = ttk.Frame(root)
    ttk.Label(side, text="Fit parameters").pack(anchor="w")
    flags_frame = ttk.Frame(side)  # rebuilt wholesale after paredit Apply
    flags_frame.pack(anchor="w", fill="y")
    flag_vars: dict[str, tk.BooleanVar] = {}

    def on_flag(name):
        def cb():
            ctrl.set_fit_flag(name, flag_vars[name].get())
        return cb

    def _refresh_flags():
        for w in flags_frame.winfo_children():
            w.destroy()
        flag_vars.clear()
        for name, free in ctrl.fit_flags().items():
            v = tk.BooleanVar(value=free)
            flag_vars[name] = v
            ttk.Checkbutton(flags_frame, text=name, variable=v,
                            command=on_flag(name)).pack(anchor="w")

    _refresh_flags()

    # ------------------------------------------------------------------ plot
    def redraw():
        ax.clear()
        x, xlabel = ctrl.x_data(xaxis.get())
        y, e, ylabel = ctrl.y_data("prefit")
        ydisp = y  # whichever residuals are front-most for overlays
        ax.errorbar(x, y, yerr=e, fmt=".", color="0.6", label="prefit",
                    alpha=0.7)
        if ctrl.postfit_model is not None:
            yp, ep, _ = ctrl.y_data("postfit")
            ax.errorbar(x, yp, yerr=ep, fmt=".", color="C0", label="postfit")
            ylabel = "residual (us)"
            ydisp = yp
            if show_random.get() and ctrl.random_dphase is not None:
                order = np.argsort(x)
                for row in ctrl.random_dphase * 1e6:
                    ax.plot(x[order], (yp + row)[order], color="C1",
                            alpha=0.15, lw=0.6)
        if show_avg.get() and xaxis.get() == "mjd":
            which = "postfit" if ctrl.postfit_model is not None else "prefit"
            am, ay, ae, albl = ctrl.averaged_y_data(which)
            ax.errorbar(am, ay, yerr=ae, fmt="s", color="C2", ms=5,
                        label=albl, zorder=5)
        sel = ctrl.selected[~ctrl.deleted]
        if sel.any() and not sel.all():
            ax.plot(x[sel], ydisp[sel], "o", mfc="none", mec="C3", ms=9,
                    label="selected")
        ax.axhline(0.0, color="k", lw=0.5)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.legend(loc="best", fontsize=8)
        canvas.draw_idle()

    def on_select_box(eclick, erelease):
        if xaxis.get() != "mjd":
            return
        lo, hi = sorted((eclick.xdata, erelease.xdata))
        n = ctrl.select_range(lo, hi)
        status.set(f"selected {n} TOAs")
        redraw()

    selector = RectangleSelector(ax, on_select_box, useblit=True, button=[1],
                                 minspanx=1e-6, spancoords="data")

    # --------------------------------------------------------------- actions
    def do_fit():
        try:
            info = ctrl.fit()
        except Exception as exc:  # surface fit errors in the GUI
            messagebox.showerror("fit failed", str(exc))
            return
        status.set(f"{info['fitter']}: chi2 {info['chi2']:.2f} / "
                   f"dof {info['dof']} — wrms {info['wrms_us']:.3f} us")
        redraw()

    def do_reset():
        ctrl.reset()
        for name, v in flag_vars.items():
            v.set(not ctrl.model.params[name].frozen)
        status.set(ctrl.summary())
        redraw()

    def do_random():
        if ctrl.fitter is None:
            messagebox.showinfo("random models", "fit first")
            return
        ctrl.random_models(30)
        show_random.set(True)
        redraw()

    def do_delete():
        n = ctrl.delete_selected()
        status.set(f"{n} TOAs remain")
        redraw()

    def do_write_par():
        path = filedialog.asksaveasfilename(defaultextension=".par")
        if path:
            ctrl.write_par(path)
            status.set(f"wrote {path}")

    def do_write_tim():
        path = filedialog.asksaveasfilename(defaultextension=".tim")
        if path:
            ctrl.write_tim(path)
            status.set(f"wrote {path}")

    # ------------------------------------------------------- editor panes
    # (reference: pint.pintk.paredit / timedit — a text editor window
    # whose Apply round-trips through the normal par/tim load paths)
    def _editor(title, get_text, apply_text, after_apply):
        win = tk.Toplevel(root)
        win.title(f"{title} — {ctrl.model.name}")
        win.geometry("700x600")
        txt = tk.Text(win, wrap="none", undo=True)
        txt.insert("1.0", get_text())

        def on_apply():
            try:
                apply_text(txt.get("1.0", "end-1c"))
            except Exception as exc:  # invalid edit: model/TOAs untouched
                messagebox.showerror(f"{title}: apply failed", str(exc),
                                     parent=win)
                return
            after_apply()
            status.set(f"{title} applied")
            redraw()

        def on_reload():
            txt.delete("1.0", "end")
            txt.insert("1.0", get_text())

        def on_open():
            path = filedialog.askopenfilename(parent=win)
            if not path:
                return
            try:
                with open(path) as f:
                    content = f.read()
            except (OSError, UnicodeDecodeError) as exc:
                messagebox.showerror(f"{title}: open failed", str(exc),
                                     parent=win)
                return
            txt.delete("1.0", "end")
            txt.insert("1.0", content)

        ebar = ttk.Frame(win)
        for label, cmd in (("Apply", on_apply), ("Reload", on_reload),
                           ("Open...", on_open)):
            ttk.Button(ebar, text=label, command=cmd).pack(side="left",
                                                           padx=2)
        ebar.pack(side="top", fill="x")
        txt.pack(side="top", fill="both", expand=True)

    def do_edit_par():
        _editor("paredit", ctrl.get_par_text, ctrl.apply_par_text,
                _refresh_flags)

    def do_edit_tim():
        _editor("timedit", ctrl.get_tim_text, ctrl.apply_tim_text,
                lambda: None)

    bar = ttk.Frame(root)
    for text, cmd in (("Fit", do_fit), ("Reset", do_reset),
                      ("Random models", do_random),
                      ("Delete selected", do_delete),
                      ("Write par", do_write_par), ("Write tim", do_write_tim),
                      ("Edit par", do_edit_par), ("Edit tim", do_edit_tim)):
        ttk.Button(bar, text=text, command=cmd).pack(side="left", padx=2)
    ttk.Checkbutton(bar, text="Avg", variable=show_avg,
                    command=redraw).pack(side="left", padx=4)
    ttk.Label(bar, text="  x:").pack(side="left")
    opt = ttk.Combobox(bar, textvariable=xaxis, values=list(X_AXES), width=13,
                       state="readonly")
    opt.bind("<<ComboboxSelected>>", lambda e: redraw())
    opt.pack(side="left")

    bar.pack(side="top", fill="x")
    side.pack(side="right", fill="y", padx=4)
    canvas.get_tk_widget().pack(side="top", fill="both", expand=True)
    ttk.Label(root, textvariable=status, anchor="w").pack(side="bottom",
                                                          fill="x")
    redraw()
    root.mainloop()
    # keep the selector alive for the mainloop's duration
    del selector
    return 0
